-- LF_CS: catalog_sales refresh (TPC-DS spec 5.3.11).
-- Reference behavior: nds/data_maintenance/LF_CS.sql.
drop view if exists csv;
create temp view csv as
select d1.d_date_sk cs_sold_date_sk,
       t_time_sk cs_sold_time_sk,
       d2.d_date_sk cs_ship_date_sk,
       c1.c_customer_sk cs_bill_customer_sk,
       c1.c_current_cdemo_sk cs_bill_cdemo_sk,
       c1.c_current_hdemo_sk cs_bill_hdemo_sk,
       c1.c_current_addr_sk cs_bill_addr_sk,
       c2.c_customer_sk cs_ship_customer_sk,
       c2.c_current_cdemo_sk cs_ship_cdemo_sk,
       c2.c_current_hdemo_sk cs_ship_hdemo_sk,
       c2.c_current_addr_sk cs_ship_addr_sk,
       cc_call_center_sk cs_call_center_sk,
       cp_catalog_page_sk cs_catalog_page_sk,
       sm_ship_mode_sk cs_ship_mode_sk,
       w_warehouse_sk cs_warehouse_sk,
       i_item_sk cs_item_sk,
       p_promo_sk cs_promo_sk,
       cord_order_id cs_order_number,
       clin_quantity cs_quantity,
       i_wholesale_cost cs_wholesale_cost,
       i_current_price cs_list_price,
       clin_sales_price cs_sales_price,
       (i_current_price - clin_sales_price) * clin_quantity cs_ext_discount_amt,
       clin_sales_price * clin_quantity cs_ext_sales_price,
       i_wholesale_cost * clin_quantity cs_ext_wholesale_cost,
       i_current_price * clin_quantity cs_ext_list_price,
       i_current_price * cc_tax_percentage cs_ext_tax,
       clin_coupon_amt cs_coupon_amt,
       clin_ship_cost * clin_quantity cs_ext_ship_cost,
       (clin_sales_price * clin_quantity) - clin_coupon_amt cs_net_paid,
       ((clin_sales_price * clin_quantity) - clin_coupon_amt) * (1 + cc_tax_percentage) cs_net_paid_inc_tax,
       (clin_sales_price * clin_quantity) - clin_coupon_amt + (clin_ship_cost * clin_quantity) cs_net_paid_inc_ship,
       (clin_sales_price * clin_quantity) - clin_coupon_amt + (clin_ship_cost * clin_quantity)
         + i_current_price * cc_tax_percentage cs_net_paid_inc_ship_tax,
       ((clin_sales_price * clin_quantity) - clin_coupon_amt) - (clin_quantity * i_wholesale_cost) cs_net_profit
from s_catalog_order
left outer join date_dim d1 on (cast(cord_order_date as date) = d1.d_date)
left outer join time_dim on (cord_order_time = t_time)
left outer join customer c1 on (cord_bill_customer_id = c1.c_customer_id)
left outer join customer c2 on (cord_ship_customer_id = c2.c_customer_id)
left outer join call_center on (cord_call_center_id = cc_call_center_id and cc_rec_end_date is null)
left outer join ship_mode on (cord_ship_mode_id = sm_ship_mode_id)
join s_catalog_order_lineitem on (cord_order_id = clin_order_id)
left outer join date_dim d2 on (cast(clin_ship_date as date) = d2.d_date)
left outer join catalog_page on (clin_catalog_page_number = cp_catalog_page_number
                                 and clin_catalog_number = cp_catalog_number)
left outer join warehouse on (clin_warehouse_id = w_warehouse_id)
left outer join item on (clin_item_id = i_item_id and i_rec_end_date is null)
left outer join promotion on (clin_promotion_id = p_promo_id);
insert into catalog_sales (select * from csv order by cs_sold_date_sk);
