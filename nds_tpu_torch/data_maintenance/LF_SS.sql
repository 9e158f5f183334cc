-- LF_SS: store_sales refresh (TPC-DS spec 5.3.11.4).
-- Build the store-sales view from the purchase staging tables joined to the
-- current dimension rows, then append it to the fact table.
-- Reference behavior: nds/data_maintenance/LF_SS.sql:31-68.
drop view if exists ssv;
create temp view ssv as
select d_date_sk ss_sold_date_sk,
       t_time_sk ss_sold_time_sk,
       i_item_sk ss_item_sk,
       c_customer_sk ss_customer_sk,
       c_current_cdemo_sk ss_cdemo_sk,
       c_current_hdemo_sk ss_hdemo_sk,
       c_current_addr_sk ss_addr_sk,
       s_store_sk ss_store_sk,
       p_promo_sk ss_promo_sk,
       purc_purchase_id ss_ticket_number,
       plin_quantity ss_quantity,
       i_wholesale_cost ss_wholesale_cost,
       i_current_price ss_list_price,
       plin_sale_price ss_sales_price,
       (i_current_price - plin_sale_price) * plin_quantity ss_ext_discount_amt,
       plin_sale_price * plin_quantity ss_ext_sales_price,
       i_wholesale_cost * plin_quantity ss_ext_wholesale_cost,
       i_current_price * plin_quantity ss_ext_list_price,
       i_current_price * s_tax_precentage ss_ext_tax,
       plin_coupon_amt ss_coupon_amt,
       (plin_sale_price * plin_quantity) - plin_coupon_amt ss_net_paid,
       ((plin_sale_price * plin_quantity) - plin_coupon_amt) * (1 + s_tax_precentage) ss_net_paid_inc_tax,
       ((plin_sale_price * plin_quantity) - plin_coupon_amt) - (plin_quantity * i_wholesale_cost) ss_net_profit
from s_purchase
left outer join customer on (purc_customer_id = c_customer_id)
left outer join store on (purc_store_id = s_store_id)
left outer join date_dim on (cast(purc_purchase_date as date) = d_date)
left outer join time_dim on (purc_purchase_time = t_time)
join s_purchase_lineitem on (purc_purchase_id = plin_purchase_id)
left outer join promotion on plin_promotion_id = p_promo_id
left outer join item on plin_item_id = i_item_id
where purc_purchase_id = plin_purchase_id
  and i_rec_end_date is null
  and s_rec_end_date is null;
insert into store_sales (select * from ssv order by ss_sold_date_sk);
