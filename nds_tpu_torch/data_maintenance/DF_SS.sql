-- DF_SS: store channel delete (TPC-DS spec 5.3.11.1). DATE1/DATE2 are
-- substituted from the generated `delete` table at run time.
-- Reference behavior: nds/data_maintenance/DF_SS.sql:30-33.
delete from store_returns where sr_ticket_number in
  (select distinct ss_ticket_number from store_sales, date_dim
   where ss_sold_date_sk = d_date_sk and d_date between date 'DATE1' and date 'DATE2');
delete from store_sales
 where ss_sold_date_sk >= (select min(d_date_sk) from date_dim
                           where d_date between date 'DATE1' and date 'DATE2')
   and ss_sold_date_sk <= (select max(d_date_sk) from date_dim
                           where d_date between date 'DATE1' and date 'DATE2');
