-- DF_I: inventory delete (TPC-DS spec 5.3.11.2). Dates come from the
-- generated `inventory_delete` table.
-- Reference behavior: nds/data_maintenance/DF_I.sql:30-32.
delete from inventory
 where inv_date_sk >= (select min(d_date_sk) from date_dim
                       where d_date between date 'DATE1' and date 'DATE2')
   and inv_date_sk <= (select max(d_date_sk) from date_dim
                       where d_date between date 'DATE1' and date 'DATE2');
